"""Language-model substrate of the port: RWKV-6 (the ``ssm`` family)."""
