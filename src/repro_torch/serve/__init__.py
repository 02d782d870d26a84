"""repro_torch.serve — persistent multi-tenant scan service over the warm
executor stack (DESIGN.md §16).

Layers: ``state`` (resident studies + warm slot cache), ``fair``
(deficit-round-robin lease policy), ``requests`` (shared executor +
request admission), ``server``/``client`` (stdlib HTTP front end).
"""
from repro_torch.serve.client import ServeClient, ServeError
from repro_torch.serve.fair import DeficitRoundRobin
from repro_torch.serve.requests import ServeExecutor, ServeHost
from repro_torch.serve.server import ServeServer
from repro_torch.serve.state import ResidentStudy, StudyRegistry

__all__ = [
    "DeficitRoundRobin",
    "ResidentStudy",
    "ServeClient",
    "ServeError",
    "ServeExecutor",
    "ServeHost",
    "ServeServer",
    "StudyRegistry",
]
