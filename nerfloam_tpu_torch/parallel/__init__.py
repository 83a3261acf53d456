"""Runners over several pipelines and ranks (port of nerfloam_tpu/parallel/):
chained submaps of one long sequence and independent sequences, one worker
per device (``subscene``), and the multi-rank layouts over
``torch.distributed`` (``sharding``): ray data parallelism of the pipeline
(``run_dp``), and JAX's dp x tp layout (``make_mesh``,
``shard_decoder_params``, ``tp_decoder_apply``,
``make_sharded_ba_iteration``)."""
