"""Worker process for tests/test_torch_serve_mesh.py's CLI cases; not a test
module.

Each invocation is one rank of a gloo process group over localhost
(``FDGAN_TPU_DIST`` and its coordinates; ``dist.mesh.run_local_ranks``
starts the ranks). Every rank runs ``fdgan_tpu_torch.cli.serve.main`` three
times, as a user would start it on each rank: a folder pass with
``--dataShards 2`` into ``<out>/data``, one with ``--spatialShards 2`` into
``<out>/spatial``, then ``--http PORT --spatialShards 2``. For the last,
rank 0 also starts a client thread that waits for the server, POSTs
``<in>/<first image>`` to /dehaze, writes the answer to ``<out>/http.png``
(with the status in ``<out>/http.status``) and stops the server with
SIGTERM, as an orchestrator would; rank 0's CLI then ends the workers' loop.

Usage: python torch_serve_cli_worker.py <in_dir> <out_dir> <port>
"""

import os
import signal
import sys
import threading
import time
import urllib.request

import torch


def client(in_dir, out_dir, port):
    url = f"http://127.0.0.1:{port}"
    name = sorted(os.listdir(in_dir))[0]
    try:
        for _ in range(600):  # the server binds after its engine is built
            try:
                urllib.request.urlopen(url + "/healthz", timeout=5).read()
                break
            except OSError:
                time.sleep(0.1)
        with open(os.path.join(in_dir, name), "rb") as f:
            req = urllib.request.Request(url + "/dehaze", data=f.read(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            body, status = resp.read(), resp.status
        with open(os.path.join(out_dir, "http.png"), "wb") as f:
            f.write(body)
        with open(os.path.join(out_dir, "http.status"), "w") as f:
            f.write(str(status))
    finally:
        os.kill(os.getpid(), signal.SIGTERM)


def main():
    in_dir, out_dir, port = sys.argv[1:4]
    torch.set_num_threads(1)
    from fdgan_tpu_torch.cli import serve
    from fdgan_tpu_torch.dist import mesh

    common = ["--device", "cpu", "--precision", "fp32", "--maxBatch", "2"]
    serve.main(common + ["--inDir", in_dir, "--outDir", os.path.join(out_dir, "data"), "--dataShards", "2"])
    serve.main(common + ["--inDir", in_dir, "--outDir", os.path.join(out_dir, "spatial"), "--spatialShards", "2"])
    if mesh.rank() == 0:
        threading.Thread(target=client, args=(in_dir, out_dir, port), daemon=True).start()
    serve.main(common + ["--http", port, "--spatialShards", "2"])
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
