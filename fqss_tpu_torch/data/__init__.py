"""Host-side data: synthetic mixtures."""

from fqss_tpu_torch.data.synthetic import synth_batch, synth_sources

__all__ = ["synth_batch", "synth_sources"]
