"""Command-line wiring shared by the port's entry points."""
