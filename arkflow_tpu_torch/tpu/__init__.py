"""Execution layer of the port: bucketing, tokenizer and the model runner."""
