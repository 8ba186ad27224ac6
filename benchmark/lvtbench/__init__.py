"""The harness of the port's benchmark: it finds a cell's files by name
(``cells``), makes its weights and inputs from the seed (``weights``,
``traffic``), drives the port (``program``; the modules of the traffic
kinds are ``benchmark/kinds/<kind>.py``), times the window (``window``),
reads the profiler (``timeline``) and checks what ran (``guard``)."""
