"""Launchers in PyTorch: the artifact store and the training launcher (the port
of ``repro.launch``'s ``artifacts`` and ``train``)."""
