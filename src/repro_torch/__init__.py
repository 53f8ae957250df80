"""repro_torch: MATCHA decentralized SGD on PyTorch and CUDA (Hopper).

The PyTorch counterpart of the ``repro`` package, module for module.
It imports ``torch`` and numpy and nothing of ``repro`` or JAX: the
numpy-only modules it needs (configs, the MATCHA planner, the corpus)
are kept here as copies, pinned to the originals by the tests.

Parameters are nested dicts of tensors keyed exactly like the JAX
pytrees, so weights carry across key for key (``repro_torch.convert``).
Entry points take an explicit ``device`` and run on ``cuda`` unless the
caller asks for the CPU.
"""
