# memex_tpu service image (reference ships a 2-stage Dockerfile:1-38).
# The default installs JAX with its CUDA 12 plugin (the wheels bring their
# own CUDA libraries; the host needs the NVIDIA driver and
# `docker run --gpus all`). PIP_EXTRA="jax" builds a CPU-backend image
# that serves the full API (encoder + index on XLA:CPU).

ARG BASE=python:3.12-slim

FROM ${BASE} AS build
RUN apt-get update && apt-get install -y --no-install-recommends \
    g++ make poppler-utils && rm -rf /var/lib/apt/lists/*
WORKDIR /app
COPY native/ native/
# Portable ISA baseline: -march=native would bake the BUILD host's CPU
# features into the .so (SIGILL on older hosts); x86-64-v2 (SSE4.2/POPCNT)
# runs on anything from the last decade.
RUN rm -rf native/build && \
    make -C native CXXFLAGS="-O3 -march=x86-64-v2 -std=c++17 -fPIC -Wall -Wextra"

FROM ${BASE}
RUN apt-get update && apt-get install -y --no-install-recommends \
    poppler-utils && rm -rf /var/lib/apt/lists/*
WORKDIR /app
COPY --from=build /app/native/build native/build
COPY memex_tpu/ memex_tpu/
COPY examples/ examples/
COPY pyproject.toml README.md ./
# Runtime deps (pyproject [project.dependencies]); PIP_EXTRA="jax" for a
# CPU-only image.
ARG PIP_EXTRA="jax[cuda12]"
RUN pip install --no-cache-dir ${PIP_EXTRA} \
    numpy aiohttp requests safetensors jsonschema

ENV HOST=0.0.0.0 PORT=8181
EXPOSE 8181
CMD ["python", "-m", "memex_tpu", "serve", "--roles", "Api,Worker"]
