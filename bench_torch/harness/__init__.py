"""The benchmark's general code: finding cells by name, the window
statistics, the device data generator, the trace reduction and the checks
that decide ``correct``. Nothing here knows a particular cell."""
