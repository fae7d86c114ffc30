"""Data parallelism over the batch axis (vhap_tpu/parallel/)."""
