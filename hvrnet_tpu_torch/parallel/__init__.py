"""Multi-device paths (counterpart of ``hvrnet_tpu/parallel/``): the
devices and ranks (``mesh.py``), launching local ranks (``launch.py``) and
the CPU rehearsal of all three scale-outs (``dryrun.py``)."""
