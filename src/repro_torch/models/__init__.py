"""Models of the port (the dense family): layers, attention, transformer, API."""
