"""Command-line entry points of the port (counterpart of
``dragonfly2_tpu/cmd``). ``replaytool``, ``manager``, ``dfstore``,
``inference`` and ``trainer`` expose ``main(argv) -> int`` and run as
``python -m dragonfly2_tpu_torch.cmd.<name>``; ``scheduler`` holds the
scheduler's manager link (``connect_manager``) and the announcer's
``TrainerClient``, and ``common`` the shared flags and bootstrap.
"""
