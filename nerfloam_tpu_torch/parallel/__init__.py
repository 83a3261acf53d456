"""Runners over several pipelines (port of nerfloam_tpu/parallel/): chained
submaps of one long sequence and independent sequences, one worker per
device (``subscene``). The JAX package's multi-chip layouts
(``parallel/sharding.py``) are not ported."""
