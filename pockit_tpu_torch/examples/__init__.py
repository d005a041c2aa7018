"""Runnable examples, the port's counterparts of the repository's
``examples/``: ``python -m pockit_tpu_torch.examples.<name> [--device cpu]``
with ``<name>`` one of ``lqr``, ``brachistochrone``, ``goddard_ascent``,
``mpc_sweep``, ``serving_aot``. Each runs on the CUDA card unless ``--device cpu``."""
