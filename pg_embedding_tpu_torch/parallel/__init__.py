from .sharded import ShardedHnswIndex

__all__ = ["ShardedHnswIndex"]
