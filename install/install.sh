#!/usr/bin/env sh
# Installer script, mirroring the reference's curl-pipe installer role
# (`/root/reference/install/install.sh`).  The reference ships
# cross-compiled binaries; the Python analogue installs the package
# (plus JAX) into the current interpreter or a fresh virtualenv.
#
# Usage:
#   ./install/install.sh            # pip install into the active env
#   LRGE_VENV=~/.lrge ./install/install.sh   # create a venv first
set -eu

REPO_URL="${LRGE_REPO_URL:-https://github.com/lrge-tpu/lrge-tpu}"
SRC_DIR="$(CDPATH= cd -- "$(dirname -- "$0")/.." && pwd)"

PY="${PYTHON:-python3}"
if [ -n "${LRGE_VENV:-}" ]; then
    echo "Creating virtualenv at $LRGE_VENV"
    "$PY" -m venv "$LRGE_VENV"
    PY="$LRGE_VENV/bin/python"
fi

if [ -f "$SRC_DIR/pyproject.toml" ]; then
    echo "Installing from source tree $SRC_DIR"
    "$PY" -m pip install "$SRC_DIR"
else
    echo "Installing from $REPO_URL"
    "$PY" -m pip install "git+$REPO_URL"
fi

# JAX backend: CPU by default; on an NVIDIA GPU machine install
# "jax[cuda12]" instead to enable the device engine
if ! "$PY" -c "import jax" 2>/dev/null; then
    "$PY" -m pip install jax
fi

"$PY" -c "import lrge_tpu; print('lrge-tpu', lrge_tpu.__version__, 'installed')"
echo "Run: lrge --help"
