from .distance import (cosine_distance, dist_one_to_many, dist_pair,
                       l2_distance, manhattan_distance, pairwise_dist)
from .bruteforce import exact_search
from .cuda_bruteforce import fused_exact_search

__all__ = [
    "dist_one_to_many",
    "dist_pair",
    "pairwise_dist",
    "l2_distance",
    "cosine_distance",
    "manhattan_distance",
    "exact_search",
    "fused_exact_search",
]
