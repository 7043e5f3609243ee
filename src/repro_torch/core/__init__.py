"""Host symbolic phase (block schedule, assembly map, which a CUDA plan
builds on its device) and the numpy Gustavson oracle."""
