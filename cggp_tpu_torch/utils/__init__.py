"""Parameter snapshots and the config-dir contract."""
