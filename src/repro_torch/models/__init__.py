"""The model zoo's dense decoder path in PyTorch: config, layers, model."""
