"""One module a model family: ``build(cfg)`` makes the program's model
configuration from a configuration file (and holds every width of the file
against it), ``Counts(cfg)`` counts the work a token and a kernel launch
need, and ``REFERENCE`` names the plain reference under
``benchkit.reference``."""
