"""Durable files: atomic writes, config fingerprints, checkpoints."""
