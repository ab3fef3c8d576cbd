"""How a configuration's system is built from its file and the seed's
data: one module per kind of system, named by the configuration's
``system`` key."""
