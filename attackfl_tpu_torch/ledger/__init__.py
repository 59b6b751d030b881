"""The cross-run ledger (the port's copy of ``attackfl_tpu/ledger``'s
record derivation and store): one distilled record per run, appended at
the end of every run, in the JAX package's format."""
