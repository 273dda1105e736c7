"""Plain versions of the port's device ops."""
