"""The paper's applications on the PyTorch port (MILC Wilson-CG so far)."""
