# Command-line checks of the port (``scripts/`` of the reference).
