"""Device operations of the port: DP recurrence, packing, kernels, traceback.

Submodules are imported explicitly by their users; importing this package
loads nothing (no kernel build, no CUDA initialisation).
"""
