"""Multi-device and multi-process execution.

Port of ``illico_tpu.parallel``: :mod:`.mesh` splits every tile over the
gene axis of a device mesh, :mod:`.cells` also splits the cell axis (the
histogram engine's counts add up over cells), and :mod:`.multihost` gives
each process of a ``torch.distributed`` job its own gene window.
"""
