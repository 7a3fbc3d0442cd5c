"""Models modules of illico_tpu_torch (mirrors illico_tpu/models)."""
