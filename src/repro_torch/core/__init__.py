"""FedQCS core, ported to PyTorch: quantizer (Lloyd-Max design), codebook,
sensing, compression (the BQCS codec), gamp, bussgang, reconstruction."""
