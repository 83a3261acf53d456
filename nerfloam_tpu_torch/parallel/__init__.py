"""Runners over several pipelines and ranks (port of nerfloam_tpu/parallel/):
chained submaps of one long sequence and independent sequences, one worker
per device (``subscene``), and ray data parallelism over
``torch.distributed`` ranks (``sharding``: the dp layout of JAX's
``make_mesh``; its tensor-parallel decoder demo is not ported)."""
