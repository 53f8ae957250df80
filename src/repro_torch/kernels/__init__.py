"""Hand-written Hopper (sm_90a) kernels and their plain PyTorch versions.

``csrc/*.cu`` holds the CUDA C++ sources, built at first use by
``build`` into shared libraries with a plain C interface and bound with
``ctypes``; ``ops`` dispatches between each kernel and its plain
version in ``ref``.
"""
