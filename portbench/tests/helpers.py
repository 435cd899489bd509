"""Helpers of the benchmark's own tests."""
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(path):
    with open(path) as f:
        return json.load(f)


def make_spec(config: str, traffic: str, limits_of: str, chips: int = 1,
              pool: int = 8, **traffic_overrides) -> dict:
    """A run's spec for a test configuration of ``configs/`` and a
    traffic mix of the benchmark, held to the limits of cell
    ``limits_of``."""
    from portbench import harness
    t = harness.load_json(harness.HERE / "traffic" / f"{traffic}.json")
    t["images"] = dict(t["images"], pool=pool)
    t.update(traffic_overrides)
    return {"bench": harness.load_json(harness.REPO / "BENCHMARK.json"),
            "cell": {"name": limits_of, "config": config, "traffic": traffic,
                     "chips": chips},
            "cfg": load(HERE / "configs" / f"{config}.json"), "traffic": t,
            "limits": harness.load_json(harness.HERE / "limits"
                                        / f"{limits_of}.json")}
