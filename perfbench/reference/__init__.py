"""Plain PyTorch references: one module a model family, and the
decentralized trainer. They import neither JAX nor either package of the
repository, and compute in float32 with TF32 off."""
