"""One module a kind of configuration: how the benchmark drives the port's
entry for it and checks what the timed path produced against the plain
reference.  A configuration's ``system`` key names the module."""
