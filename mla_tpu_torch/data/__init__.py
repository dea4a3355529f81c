"""Wire quantizers (PCM16, mu-law)."""
