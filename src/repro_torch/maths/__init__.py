"""Shared numerical building blocks (SU(3)/Dirac algebra)."""
