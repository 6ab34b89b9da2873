"""PyTorch / CUDA port of ``litepose_tpu`` for NVIDIA Hopper GPUs.

The JAX package ``litepose_tpu`` is the reference; this package mirrors its
layout (``models/``, ``core/``, ``ops/``, ``train/``, ``data/``,
``config/``) and holds the hand-written CUDA kernels in ``csrc/`` (with the
host C++ JPEG decoder and polygon fill), built by ``kernels/``.
It never imports jax, cv2, yaml, PIL or flax.  Ported so far: serving
(``core.engine.PoseEngine.process_batch_square``), the eval protocol
(``PoseEngine.process``, ``process_indexed``, ``process_many``), the
dataset eval CLI (``tools.valid``), training (``train.trainer.StepFns``,
``data.dataset.TrainPipeline``, ``train.checkpoint``,
``tools.make_bench_ckpt``), the NAS CLIs, the baseline families, and
deployment (``core.export``: the serving program as a ``torch.export``
artifact with the kernels as ``torch.ops.litepose.*``; ``tools.export``,
``tools.demo``, ``utils.vis``, ``utils.summary``), and data parallelism
(``parallel``: multi-process training with JAX's global BN statistics,
``PoseEngine(mesh=)``, the eval CLI's ``--devices``).
"""
