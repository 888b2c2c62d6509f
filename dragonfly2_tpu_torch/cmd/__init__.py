"""Command-line entry points of the port (counterpart of
``dragonfly2_tpu/cmd``). Each module exposes ``main(argv) -> int`` and
runs as ``python -m dragonfly2_tpu_torch.cmd.<name>``; only
``replaytool`` is ported.
"""
