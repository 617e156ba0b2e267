"""Diagnostic entry points of the PyTorch port (``python -m
stratified_transformer_torch.tools.<name>``): the bin-math and
build-cache probes."""
