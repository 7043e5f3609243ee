"""Model configurations the port can run (see :mod:`.registry`)."""
