"""Dense decoder model of the port: layers, attention, assembly."""
