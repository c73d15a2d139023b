"""FedQCS core, ported to PyTorch: quantizer (Lloyd-Max design), codebook
(lloyd_max / dithered_uniform / vq), sparsify, sensing, layout (the
parameter dict <-> block-grid geometry: monolithic or per-tensor),
compression (the BQCS codec), gamp (EM-GAMP / Q-EM-GAMP), bussgang,
reconstruction (EA / AE), recon_engine (the chunked PS decode, the
segment-local EA decode and the decode from streamed statistics), aggregator (the streamed round's partial statistics and their
carry-save tree), baselines (SignSGD, QCS-Dither, QCS-QIHT) and api (the
one-call interface, re-exported here as the reference's ``repro.core``
does)."""

from repro_torch.core.api import (  # noqa: F401
    BQCSCodec,
    CompressorState,
    FedQCSConfig,
    compress,
    init_state,
    make_codec,
    reconstruct,
)
