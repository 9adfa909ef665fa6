"""Data- and tensor-parallel training over ``torch.distributed`` (port of
``multimodal_survival_prediction_tpu/parallel``): meshes (``mesh``), the
collectives GSPMD inserts in JAX (``collectives``), the sharding rules
(``sharding``), multi-process runs (``multihost``) and the multi-device dry
run (``dryrun``). One process a device; a "mesh" is a ``DeviceMesh`` with
dims ``("data", "model")`` over the ranks of the default group."""
