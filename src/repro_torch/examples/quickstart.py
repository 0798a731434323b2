# Port of examples/quickstart.py.
"""Quickstart — the paper's Fig. 2 flow, verbatim API.

1. configure the AL service from a YAML file (config-as-a-service)
2. start the server
3. push unlabeled data from a client
4. query a budget of samples to label

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart
(on the GPU; ``--device cpu`` runs it on the CPU). The YAML's ``device``
is the flag's value: the port's server computes where its config says.
"""
from __future__ import annotations

import argparse

from repro_torch.data.synthetic import image_pool
from repro_torch.service.client import ALClient, serve_tcp
from repro_torch.service.config import ALServiceConfig
from repro_torch.service.server import ALServer

EXAMPLE_YML = """
name: "IMG_CLASSIFICATION"
version: 0.1
active_learning:
  strategy:
    type: "lc"
  model:
    name: "synthetic_cnn"
    batch_size: 16
  device: {device}
al_worker:
  protocol: "tcp"
  host: "127.0.0.1"
  port: 0
  replicas: 1
"""
POOL, BUDGET = 400, 10


def run(device="cuda", backend=None, draws=None, log: bool = True) -> dict:
    """The flow end to end over TCP. ``backend`` and ``draws`` go to
    ``ALServer`` (None: built from the config, and the production
    draws). Returns the selected ``indices`` and ``keys``, the
    ``strategy``, the ``accuracy`` after labeling them and the server's
    ``device``."""
    # 1. configure
    config = ALServiceConfig.from_yaml(EXAMPLE_YML.format(device=device))
    if log:
        print(f"service: {config.name} strategy={config.strategy} "
              f"model={config.model_name} device={config.device}")

    # 2. start server (+ TCP endpoint, the gRPC stand-in)
    al_server = ALServer(config, backend=backend, draws=draws)
    rpc = serve_tcp(al_server, config.host, config.port)
    al_client = ALClient(url=f"{config.host}:{rpc.port}")
    try:
        if log:
            print(f"server listening on {config.host}:{rpc.port}")

        # 3. client pushes the unlabeled pool
        data_list, labels = image_pool(POOL, seed=3)
        keys = al_client.push_data(list(data_list))
        if log:
            print(f"pushed {len(keys)} samples; "
                  f"cache entries: {al_client.stats()['cache']['entries']}")

        # 4. query a labeling budget
        selected = al_client.query(budget=BUDGET)
        if log:
            print(f"strategy {selected['strategy']} selected "
                  f"{len(selected['keys'])} samples: indices "
                  f"{selected['indices']}")

        # 5. human-in-the-loop: label and update the model
        key2y = dict(zip(keys, (int(y) for y in labels)))
        al_client.label(selected["keys"],
                        [key2y[k] for k in selected["keys"]])
        acc = al_client.train_eval()
        if log:
            print(f"model updated on labeled set; (train-set) accuracy "
                  f"proxy = {acc}")
        return {"indices": list(selected["indices"]),
                "keys": list(selected["keys"]),
                "strategy": selected["strategy"], "accuracy": acc,
                "device": al_client.stats()["device"]}
    finally:
        al_client.close()
        rpc.stop()
        al_server.close()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap


def main():
    run(device=parser().parse_args().device)


if __name__ == "__main__":
    main()
