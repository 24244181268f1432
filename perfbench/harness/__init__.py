"""The benchmark's inputs, work counts, trace reading, report and output
check: the yardstick, which reads the program only through its entry
points (in ``runners/``)."""
