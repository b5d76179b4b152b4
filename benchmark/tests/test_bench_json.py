"""BENCHMARK.json holds together: every name a metric's ``workloads`` lists is a
cell, every cell's configuration and traffic mix exist, every configuration
has a cell, and few cells take four chips.  JSON and files only, no run."""

import pytest

from benchmark.common import HERE, ROOT, load_json


@pytest.fixture(scope="module")
def bench():
    return load_json(ROOT / "BENCHMARK.json")


def test_every_metric_lists_only_cells_that_exist(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for metric in bench["end_to_end"] + bench["per_layer"]:
        missing = set(metric.get("workloads", ())) - cells
        assert not missing, (metric["name"], missing)


def test_every_cell_names_a_configuration_and_a_traffic_file_that_exist(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for cell in bench["workloads"]:
        assert cell["config"] in configs, cell["name"]
        assert (ROOT / configs[cell["config"]]["file"]).is_file(), cell["name"]
        assert (HERE / "traffic" / f"{cell['traffic']}.json").is_file(), cell["name"]


def test_every_configuration_has_a_cell(bench):
    unused = {c["name"] for c in bench["configs"]} - {cell["config"] for cell in bench["workloads"]}
    assert not unused, unused


def test_at_most_a_quarter_of_the_cells_take_four_chips(bench):
    four = [cell["name"] for cell in bench["workloads"] if cell["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4), four
