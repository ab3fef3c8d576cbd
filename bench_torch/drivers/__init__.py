"""Traffic drivers, one module each, named by a traffic mix's ``driver``
key (``traffic/<mix>.json``) and read from its parameters."""
