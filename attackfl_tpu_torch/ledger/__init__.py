"""The cross-run ledger (the port's copy of ``attackfl_tpu/ledger``'s
record derivation, store, comparison and command line): one distilled
record per run, appended at the end of every run, in the JAX package's
format; ``ledger list|show|compare|regress|import`` (:mod:`~.cli`) turns the
store into queries, diffs and a noise-aware regression gate
(:mod:`~.compare`)."""
