"""The plain reference that decides `correct` (check.py) and the frozen
plain code it runs (vio/). Nothing here imports the port or JAX."""
