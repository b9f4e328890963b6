"""Host-side data helpers the port needs (its own copies; numpy only)."""
