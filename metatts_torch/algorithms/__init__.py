"""Training systems registry (reference ``lightning/systems/__init__.py:5-14``)."""

from .baseline import BaselineSystem
from .meta import MetaSystem

SYSTEMS = {
    "baseline": BaselineSystem,
    "meta": MetaSystem,
}


def get_system(algorithm_type):
    if algorithm_type == "imaml":
        raise NotImplementedError(
            "the iMAML system (algorithms/imaml.py) is not ported yet: "
            "ROADMAP Queue 1 item 9")
    return SYSTEMS[algorithm_type]
