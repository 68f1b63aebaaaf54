"""mmlspark_tpu_torch — the PyTorch/CUDA port of mmlspark_tpu.

A package of its own beside the JAX package, which stays the reference
the port is held against. It imports torch, numpy and the standard
library, never jax, flax or any module of ``mmlspark_tpu``: where it needs
such code it keeps its own copy. Module names follow the JAX package's,
so a module's counterpart is easy to find.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:mod:`mmlspark_tpu_torch.device`). Every Pallas kernel on a ported path
is a CUDA C++ kernel written for Hopper (``ops/csrc``), with its plain
PyTorch version beside it; a CPU tensor takes the plain version, a CUDA
tensor the kernel.

Six paths are ported so far:

* serving ViT-B/16 through :class:`ModelServer`: ``ModelServer.add_model``
  → ``DynamicBatcher`` → ``core.plan`` → ``TorchModel`` forward, with
  ``ops.attention.flash_attention`` as the hand-written CUDA kernel (its
  bf16 instance on the tensor cores);
* training the GroupNorm ResNet-50 on one device: ``Trainer.fit_arrays``
  → ``DeviceLoader`` → one step (``DevicePreprocess`` with
  ``ops.resize.fused_resize_norm``, the forward with
  ``ops.group_norm.group_norm`` at every norm site, a masked loss, the
  backward and the optimizer), both ops hand-written CUDA kernels;
* token generation through :class:`ModelServer`:
  ``ModelServer.add_generator`` → ``GenerateBatcher`` (continuous batching
  over a slot-major KV cache) → the causal ``TransformerTagger``, whose
  decode step attends through ``ops.attention.decode_attention``, a
  hand-written CUDA kernel;
* sequence-parallel training of the causal ``TransformerTagger``:
  ``Trainer(model, TrainConfig(mesh_spec={"sp": 4})).fit_arrays`` → the
  model's ``mesh_hooks`` → ``parallel.ring_attention`` over the ``sp``
  virtual ranks of a mesh on one card, every hop of every layer one
  ``ops.attention.attention_block_update``, a hand-written CUDA kernel;
* the CIFAR-10 ConvNet, trained through ``Trainer.fit_arrays`` and scored
  through ``TorchModel`` (no hand-written kernel on its path);
* columnar pipelines: ``Pipeline``/``PipelineModel`` → ``core.plan``,
  which runs each maximal run of device stages (``ImageTransformer``,
  ``UnrollImage``, ``ImageFeaturizer``, ``TorchModel``) as one forward per
  minibatch with one upload and one fetch round; ``ImageFeaturizer`` over
  ResNet-50 runs ``ops.group_norm.group_norm`` at every norm site.

ROADMAP.md lists the slices still to come.
"""

__version__ = "0.1.0"
