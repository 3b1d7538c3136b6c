"""Command-line entry points (counterpart of ``pose3d_tpu.cli``):
``python -m pose3d_tpu_torch.cli.main`` trains, ``python -m
pose3d_tpu_torch.cli.evaluate`` evaluates, ``cli.infer`` lifts images,
``cli.export`` writes a serving artifact, ``cli.convert`` converts
checkpoints, ``cli.chunker``, ``cli.split`` and ``cli.rechunker``
write, split and shuffle the chunk archives, ``cli.preprocess`` runs stage 1
and ``cli.doctor`` reports the environment. Each is also a
``pose3d-torch-*`` console script."""
