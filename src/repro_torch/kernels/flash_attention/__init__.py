"""Causal online-softmax attention forward (prefill), GQA, window and
softcap."""
