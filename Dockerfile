# Production image: CLI + library on CPU. For GPU serving, base on a
# CUDA-enabled JAX image and keep the same steps.
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ make \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /app
COPY pyproject.toml README.md ./
COPY audio_pattern_detector_tpu ./audio_pattern_detector_tpu
COPY csrc ./csrc

RUN pip install --no-cache-dir jax numpy && \
    pip install --no-cache-dir --no-deps . && \
    make -C csrc

# stdout is reserved for JSONL events; logs go to stderr.
ENTRYPOINT ["audio-pattern-detector-tpu"]
