"""The systems under test. A configuration's ``system`` and its traffic
mix's ``entry`` name the module ``perfbench/systems/<system>/<entry>.py``,
whose ``Entry(config, traffic, seed, device)`` sets up and warms up the
program and then offers:

* ``product(i)`` and ``call(i)``: request ``i``'s name and the call that
  serves it (a closed loop's client calls it);
* ``counters()``: the program's counters, differenced over the window;
* ``spans``: host-clock spans the entry took around calls into the program;
* ``extra_checks(counters, requests)``: exact numbers (limit 0) that the
  window itself must satisfy;
* ``release()``: free the program's state before the reference runs;
* ``check(kept, control=False)``: the numbers compared with the plain
  reference for the kept results, and how many were compared;
* ``least_seconds(i)``: request ``i``'s least chip time, or ``None``.
"""
