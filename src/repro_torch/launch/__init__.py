"""Entry points: the virtual tile mesh and the serving launcher."""
