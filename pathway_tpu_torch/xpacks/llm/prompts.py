"""Prompt templates (reference ``python/pathway/xpacks/llm/prompts.py``).

Copy of ``pathway_tpu/xpacks/llm/prompts.py``.
"""

from __future__ import annotations

__all__ = [
    "prompt_qa",
    "prompt_short_qa",
    "prompt_citing_qa",
    "prompt_summarize",
    "prompt_qa_geometric_rag",
]

NO_INFO_ANSWER = "No information found."


def _docs_text(docs) -> str:
    parts = []
    for d in docs or ():
        if isinstance(d, dict):
            parts.append(str(d.get("text", d)))
        else:
            parts.append(str(d))
    return "\n\n".join(parts)


def prompt_qa(
    query: str,
    docs,
    information_not_found_response: str = NO_INFO_ANSWER,
    additional_rules: str = "",
) -> str:
    return (
        "Please provide an answer based solely on the provided sources. "
        f"If the sources do not contain the answer, reply exactly with "
        f"'{information_not_found_response}'.{additional_rules}\n\n"
        f"Sources:\n{_docs_text(docs)}\n\n"
        f"Query: {query}\nAnswer:"
    )


def prompt_short_qa(query: str, docs, additional_rules: str = "") -> str:
    return prompt_qa(
        query,
        docs,
        additional_rules=" Answer as briefly as possible, ideally a single "
        "word or phrase." + additional_rules,
    )


def prompt_citing_qa(query: str, docs, additional_rules: str = "") -> str:
    return prompt_qa(
        query,
        docs,
        additional_rules=" Cite the source of each claim in square "
        "brackets, e.g. [1]." + additional_rules,
    )


def prompt_summarize(text_list) -> str:
    joined = "\n".join(str(t) for t in text_list or ())
    return (
        "Summarize the following texts into a single concise summary.\n\n"
        f"{joined}\n\nSummary:"
    )


def prompt_qa_geometric_rag(
    query: str,
    docs,
    information_not_found_response: str = NO_INFO_ANSWER,
    additional_rules: str = "",
) -> str:
    """The adaptive-RAG prompt: strict no-hallucination instruction so the
    'not found' sentinel is reliable (reference prompts.py)."""
    return (
        "Use the below articles to answer the subsequent question. If the "
        "answer cannot be found in the articles, write exactly "
        f"'{information_not_found_response}'. Do not use outside knowledge."
        f"{additional_rules}\n\n"
        f"Articles:\n{_docs_text(docs)}\n\n"
        f"Q: {query}\nA:"
    )
