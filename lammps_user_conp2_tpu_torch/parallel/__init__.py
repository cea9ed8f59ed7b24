"""The multi-device MD step: ``comm`` (process groups and collectives over
``torch.distributed``) and ``sharded`` (the sharded engine)."""
