"""Kernel packages of the port.  Each has:
  kernel.py  the CUDA wrappers (csrc/*.cu) beside their plain versions
  ref.py     the pure-torch oracle (also the "torch" engine)
  ops.py     the public wrapper with engine dispatch
"""
