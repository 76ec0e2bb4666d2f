"""Server, client, buffer, packer and weight rules of the port.

Import the submodules directly (``repro_torch.core.server`` etc.): the
kernels' ops import ``core.aggregation``, and the server imports the ops, so
this package imports nothing itself.
"""
