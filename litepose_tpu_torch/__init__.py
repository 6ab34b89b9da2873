"""PyTorch / CUDA port of ``litepose_tpu`` for NVIDIA Hopper GPUs.

The JAX package ``litepose_tpu`` is the reference; this package mirrors its
layout (``models/``, ``core/``, ``ops/``, ``train/``, ``data/``) and holds
the hand-written CUDA kernels in ``csrc/`` with their builder in
``kernels/``.  It never imports jax, cv2, yaml or flax.  Ported so far:
serving (``core.engine.PoseEngine.process_batch_square``), the eval
protocol (``PoseEngine.process``, ``process_indexed``, ``process_many``)
and training (``train.trainer.StepFns``, ``data.dataset.TrainPipeline``,
``train.checkpoint``, ``tools.make_bench_ckpt``).
"""
