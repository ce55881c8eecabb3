"""The benchmark's general code: traffic, the window's arithmetic, the
profile reduction and the run of a cell."""
