"""Wire quantizers (PCM16, mu-law), synthetic datasets, samplers, batch gather."""
