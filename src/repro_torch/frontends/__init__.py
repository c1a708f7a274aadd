from . import deploy, extract, nn, offload
from .offload import device as device_api
from .optimize import SolModel, compile_graph, optimize

__all__ = ["nn", "extract", "offload", "deploy", "optimize", "compile_graph",
           "SolModel", "device_api"]
