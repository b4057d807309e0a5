"""PyTorch/CUDA port of distributed_llm_pipeline_tpu: GGUF loading, the
llama-family forward with a hand-written CUDA attention kernel, the sampler
chain, the single-stream engine and the /chat SSE server."""
