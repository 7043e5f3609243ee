"""Host symbolic phase (block schedule, assembly map) and the numpy
Gustavson oracle."""
