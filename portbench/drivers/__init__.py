"""One module a kind of traffic; ``traffic/<mix>.json`` names it under
``driver``.  See ``portbench/harness.py`` for the functions a driver
has."""
