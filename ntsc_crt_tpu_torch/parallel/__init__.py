"""Frame slots split over CUDA cards (mesh.py), and each frame's lines
over a group of cards (spatial.py)."""
