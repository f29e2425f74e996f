"""The benchmark's plain reference: plain PyTorch, nothing of the program
under test. ``weights`` makes the experts both sides run; ``dit`` samples
from them as the published blocks compute."""
