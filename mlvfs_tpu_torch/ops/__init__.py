"""Device ops of the port: each module is the counterpart of the same name in
``mlvfs_tpu.ops``."""
