"""Multi-device parallelism on ``torch.distributed``: the process group and
its meshes (``comm``), one process per rank (``launch``), data-parallel
training (``dp``), halo-exchange spatial inference (``spatial``) and the
multi-rank dry run (``dryrun``). Counterpart of ``runet_tpu/parallel``."""
