from .graph import GraphState, empty_graph

__all__ = ["GraphState", "empty_graph"]
