"""Usage walkthroughs of the port, one per JAX example under ``examples/``:
``python -m qldpc_tpu_torch.examples.quickstart`` (``noise_models``,
``degeneracy_count``), each on the card unless given ``--device cpu``."""
