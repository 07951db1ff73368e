"""Card-side tools of the port (run with `python3 -m`)."""
