"""Launchers of the port: batched lattice-solve serving and LM decode
(``launch.serve``)."""
