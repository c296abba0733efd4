"""Training systems registry (reference ``lightning/systems/__init__.py:5-14``)."""

from .baseline import BaselineSystem
from .imaml import IMAMLSystem
from .meta import MetaSystem

SYSTEMS = {
    "baseline": BaselineSystem,
    "meta": MetaSystem,
    "imaml": IMAMLSystem,
}


def get_system(algorithm_type):
    return SYSTEMS[algorithm_type]
