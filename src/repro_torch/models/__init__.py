"""Dense decoder LM (``lm``), attention paths, norms/RoPE, weight bridge."""
