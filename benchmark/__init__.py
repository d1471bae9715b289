"""The benchmark of qldpc_tpu_torch: see README.md."""
