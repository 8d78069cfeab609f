# Two-stage image, mirroring the reference's Dockerfile role
# (`/root/reference/Dockerfile:1-28`: builder stage + slim runtime).
# Stage 1 builds the wheel and pre-compiles the native C++ kernels;
# stage 2 is a slim runtime with only the installed package.
#
# The image installs CPU-only JAX and runs the full CLI with the host
# engine.  For the GPU device engine install JAX's CUDA plugin instead
# (`pip install "jax[cuda12]"`) on a machine with an NVIDIA driver.

FROM python:3.12-slim AS builder
RUN apt-get update && apt-get install -y --no-install-recommends \
    g++ && rm -rf /var/lib/apt/lists/*
WORKDIR /src
COPY pyproject.toml README.md ./
COPY lrge_tpu ./lrge_tpu
RUN pip install --no-cache-dir build && python -m build --wheel
# pre-compile the native sketch/chain kernels into the wheel's package
RUN pip install --no-cache-dir dist/*.whl jax \
    && python -c "from lrge_tpu.native import HAVE_NATIVE; print('native:', HAVE_NATIVE)"

FROM python:3.12-slim
RUN apt-get update && apt-get install -y --no-install-recommends \
    g++ && rm -rf /var/lib/apt/lists/*
COPY --from=builder /src/dist /dist
RUN pip install --no-cache-dir /dist/*.whl jax zstandard && rm -rf /dist
ENTRYPOINT ["lrge"]
