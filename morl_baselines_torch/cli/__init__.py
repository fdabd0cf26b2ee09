from .experiments import ALGOS, StoreDict

__all__ = ["ALGOS", "StoreDict"]
