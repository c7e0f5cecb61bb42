"""Imported by the port's CPU test files for its side effect: one torch
thread per process. The suite runs several workers on one machine; with a
thread pool each, they fight over the cores and small ops slow down
manyfold."""

import torch

torch.set_num_threads(1)
