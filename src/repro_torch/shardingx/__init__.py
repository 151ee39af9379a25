"""Sharding rules of the launch tier (counterpart of ``repro.shardingx``):
``policy`` resolves a PartitionSpec per tensor, ``constrain`` the logical
activation constraints."""
