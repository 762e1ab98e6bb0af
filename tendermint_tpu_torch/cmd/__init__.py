"""CLI (reference cmd/tendermint/): init, start, testnet, show-node-id,
show-validator, unsafe-reset-all, version.  Run as
`python -m tendermint_tpu_torch.cmd <command>`."""
