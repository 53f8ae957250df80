"""Crash-safe checkpoints of node-stacked training state, in the JAX
package's on-disk format (``repro_torch.checkpoint.ckpt``), with a
MessagePack codec of the port's own (``repro_torch.checkpoint.mpack``)."""
