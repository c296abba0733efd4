"""``python -m perfbench ...``: the same as ``python3 perfbench/run.py ...``."""

from perfbench.run import main

main()
