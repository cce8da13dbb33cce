"""The benchmark's general code: the specification, the closed loop, the
trace reader and the result line.  Everything that belongs to one
configuration, traffic mix or metric lives in a file of its own beside
this package and is found by name."""
