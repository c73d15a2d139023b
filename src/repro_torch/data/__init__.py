"""Datasets: the MNIST loader and its offline synthMNIST surrogate."""
