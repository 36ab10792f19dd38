"""How a cell is driven, one module a kind of traffic: a mix's ``loop``
names its module here, whose ``run(bench, cell, seed, seconds, trace,
device, t_proc, **kw)`` makes one run and returns its result."""
