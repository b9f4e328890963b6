"""Multi-device helpers (only ``multihost.shard_plan`` so far)."""
