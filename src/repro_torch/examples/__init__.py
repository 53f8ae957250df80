"""The port's examples, each run as ``python -m repro_torch.examples.<name>``
(on the card, or on the CPU with ``--device cpu``): ``quickstart``,
``topology_explorer``, ``serve_batched`` and ``train_decentralized``."""
