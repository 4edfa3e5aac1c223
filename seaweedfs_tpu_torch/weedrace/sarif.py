"""SARIF 2.1.0 emission for the port's weedrace: the same schema subset as
the repo's analysis tools emit (tool.driver with the rule table, one
result per violation with a physical location), kept here so the port
imports none of them."""

from __future__ import annotations

from pathlib import Path

from seaweedfs_tpu_torch.weedrace import RULES, __version__

_SCHEMA = "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/Schemata/sarif-schema-2.1.0.json"


def to_sarif(violations) -> dict:
    rule_ids = sorted({r.code for r in RULES} | {v.rule for v in violations})
    summaries = {r.code: r.summary for r in RULES}
    return {
        "$schema": _SCHEMA,
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "weedrace",
                        "informationUri": "STATIC_ANALYSIS.md",
                        "version": __version__,
                        "rules": [
                            {
                                "id": code,
                                "shortDescription": {
                                    "text": summaries.get(code, code)
                                },
                            }
                            for code in rule_ids
                        ],
                    }
                },
                "results": [
                    {
                        "ruleId": v.rule,
                        "level": "error",
                        "message": {"text": v.message},
                        "locations": [
                            {
                                "physicalLocation": {
                                    "artifactLocation": {
                                        "uri": Path(v.path).as_posix()
                                    },
                                    "region": {"startLine": max(v.line, 1)},
                                }
                            }
                        ],
                    }
                    for v in violations
                ],
            }
        ],
    }

