"""Remote-signer conformance harness (reference tools/tm-signer-harness).

The harness plays the NODE side of the privval socket protocol: it
listens on an address, waits for a remote signer to dial in, then runs
the conformance checks the reference harness runs — pubkey retrieval,
vote and proposal signatures that verify against canonical sign bytes,
and double-sign refusal (same HRS, different block).  Exit code /
result list tells an external signer implementation (HSM bridge, tmkms
analog) whether it is protocol-compatible.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from tendermint_tpu_torch.privval.signer import SignerClient
from tendermint_tpu_torch.types.basic import (BlockID, PartSetHeader,
                                        SignedMsgType, Timestamp)
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import Vote


@dataclass
class HarnessResult:
    passed: List[str] = field(default_factory=list)
    failed: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failed

    def record(self, name: str, ok: bool, detail: str = ""):
        (self.passed if ok else self.failed).append(
            name if not detail or ok else f"{name}: {detail}")


HARNESS_CHAIN_ID = "signer-harness-chain"


def _block_id(seed: bytes) -> BlockID:
    import hashlib
    h = hashlib.sha256(seed).digest()
    return BlockID(h, PartSetHeader(1, hashlib.sha256(h).digest()))


def run_harness(client: SignerClient,
                chain_id: str = HARNESS_CHAIN_ID) -> HarnessResult:
    """Run the conformance checks against a connected signer client
    (reference tm-signer-harness TestPublicKey/TestSignVote/
    TestSignProposal)."""
    res = HarnessResult()

    # 1. pubkey retrieval
    try:
        pub = client.get_pub_key()
        res.record("pubkey", pub is not None and len(pub.bytes()) == 32)
    except Exception as e:
        res.record("pubkey", False, str(e))
        return res  # nothing else can run

    # 2. proposal signature verifies against canonical sign bytes
    prop = Proposal(height=1, round=0, pol_round=-1,
                    block_id=_block_id(b"harness-prop"),
                    timestamp=Timestamp(1700000100, 0))
    try:
        signed = client.sign_proposal(chain_id, prop)
        ok = pub.verify_signature(signed.sign_bytes(chain_id),
                                  signed.signature)
        res.record("sign_proposal", ok, "signature does not verify")
    except Exception as e:
        res.record("sign_proposal", False, str(e))

    # 3. prevote + precommit signatures verify
    for step, mtype in (("prevote", SignedMsgType.PREVOTE),
                        ("precommit", SignedMsgType.PRECOMMIT)):
        vote = Vote(type=mtype, height=2, round=0,
                    block_id=_block_id(b"harness-vote"),
                    timestamp=Timestamp(1700000200, 0),
                    validator_address=pub.address(), validator_index=0)
        try:
            signed = client.sign_vote(chain_id, vote)
            ok = pub.verify_signature(signed.sign_bytes(chain_id),
                                      signed.signature)
            res.record(f"sign_{step}", ok, "signature does not verify")
        except Exception as e:
            res.record(f"sign_{step}", False, str(e))

    # 4. double-sign refusal: same (height, round, step), different block
    vote_a = Vote(type=SignedMsgType.PREVOTE, height=3, round=0,
                  block_id=_block_id(b"block-a"),
                  timestamp=Timestamp(1700000300, 0),
                  validator_address=pub.address(), validator_index=0)
    vote_b = Vote(type=SignedMsgType.PREVOTE, height=3, round=0,
                  block_id=_block_id(b"block-b"),
                  timestamp=Timestamp(1700000301, 0),
                  validator_address=pub.address(), validator_index=0)
    try:
        client.sign_vote(chain_id, vote_a)
        refused = False
        try:
            client.sign_vote(chain_id, vote_b)
        except Exception:
            refused = True
        res.record("double_sign_refusal", refused,
                   "signer signed two different blocks at the same HRS")
    except Exception as e:
        res.record("double_sign_refusal", False, f"first sign failed: {e}")

    # 5. timestamp-only re-sign of the SAME block is allowed (reference
    # privval/file.go checkVotesOnlyDifferByTimestamp)
    vote_c = Vote(type=SignedMsgType.PREVOTE, height=3, round=0,
                  block_id=_block_id(b"block-a"),
                  timestamp=Timestamp(1700000302, 0),
                  validator_address=pub.address(), validator_index=0)
    try:
        signed = client.sign_vote(chain_id, vote_c)
        ok = pub.verify_signature(signed.sign_bytes(chain_id),
                                  signed.signature)
        res.record("same_block_resign", ok)
    except Exception as e:
        res.record("same_block_resign", False, str(e))

    return res
