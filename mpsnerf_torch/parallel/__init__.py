"""Multi-device training and rendering (port of ``mpsnerf_tpu/parallel``):
``mesh`` (the (data, ray) grid of ranks, ``MeshTrainer``, the sharded
steps and render), ``collectives`` (named axes, the bucketed mean),
``launch`` (ranks on this host) and ``dryrun`` (the multi-device dry
run).  Import the modules themselves (``mpsnerf_torch.parallel.mesh``):
``mesh`` imports the trainer, which imports ``collectives`` from this
package, so the package imports none of them."""
